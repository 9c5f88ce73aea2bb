"""The benchmark's plain reference: frozen, plain PyTorch.

It is the yardstick that decides ``correct``, so it shares no code with the
program under test: it imports no kernel, nothing of ``centernet_tpu_torch``
and nothing of JAX. It holds its parameters in a flat dict keyed as the
port's ``state_dict`` (``backbone.base.level0.0.weight``, ...), so that one
seeded state loads into both sides.

* ``nn``: convolutions, BatchNorm and a plain DCNv2 (``F.grid_sample``), in
  float32, or through a rounding function (``fp8``) for the control.
* ``dla34``: DLA-34 with the DLAUp / IDAUp up-path of DCN layers.
* ``heads``, ``detection``, ``multi_pose``: the head convs, target encoders,
  losses and the ``ctdet`` decode.
* ``adam``: plain Adam.
* ``letterbox``: the fixed-size resize, pad and normalisation of a frame.

Each module is a frozen copy of what the configuration states; where it
copies the port's arithmetic (the target splats, the antialiased resize) it
is a copy, not a call.
"""
