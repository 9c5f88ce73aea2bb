"""Data helpers of the PyTorch port (host-side, numpy)."""
