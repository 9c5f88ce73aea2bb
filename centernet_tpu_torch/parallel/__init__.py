"""Training, PyTorch port of ``centernet_tpu/parallel``: the train step."""
