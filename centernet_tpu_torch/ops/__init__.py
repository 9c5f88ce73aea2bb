"""Compute ops of the PyTorch port: DCNv2 (plain and CUDA), decode, gathers.

Import the submodules directly (``centernet_tpu_torch.ops.dcn``, ...).
"""
