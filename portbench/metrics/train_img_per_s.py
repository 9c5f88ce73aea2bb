"""train_img_per_s: training images stepped in the window over its
seconds; the window ends in a synchronisation, so every step counted has
run."""


def read(r):
    if r.kind != "train" or not r.window_s:
        return None
    return r.steps * r.batch / r.window_s
