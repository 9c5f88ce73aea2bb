"""Shared arithmetic of the device readers (not a metric)."""


def idle_pct(r):
    """100 x (1 - busy / wall) over the traced stretch, or None where the
    profile lost records."""
    st = r.stretch
    if st is None or not st.complete or st.window_s <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s() / st.window_s)


def rate(r):
    """Images per second of the untraced window: for serving, those whose
    answers reached the host inside it."""
    if r.kind == "serve":
        done = sum(1 for _, end in r.requests if end <= r.seconds)
        return done * r.batch / r.seconds
    return r.steps * r.batch / r.window_s if r.window_s else None


def mfu(r, factor):
    """Operations of ``factor`` forwards per image (the benchmark's count for
    the cell's kind of request) times the window's images per second, over
    the bf16 peak, in %."""
    images = rate(r)
    if not images:
        return None
    flops = factor * r.counts.flops_per_image(r.config, r.kind)
    peak = r.counts.peak_flops(r.config["compute_dtype"])
    return 100.0 * flops * images / peak


def roofline(r, kernel, bound):
    """The least time of the stretch's ``kernel`` launches (``bound`` per
    layer shape) over the traced time of the kernels whose names hold
    ``kernel``, in %."""
    st = r.stretch
    if st is None or not st.complete or not st.launched.get(kernel):
        return None
    layers = r.counts.dcn_layers(r.config)
    passes = st.launched[kernel] / len(layers)
    b = r.batch
    least = passes * sum(bound(b, h, w, ci, co, r.config["compute_dtype"])
                         for h, w, ci, co in layers)
    spent = st.kernel_s(kernel)
    return 100.0 * least / spent if spent > 0 else None
