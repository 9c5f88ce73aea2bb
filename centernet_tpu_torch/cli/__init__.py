"""Command-line entry points of the PyTorch port: ``cli.detection``
(train + eval) and ``cli.test`` (eval of a checkpoint or of legacy
weights)."""
