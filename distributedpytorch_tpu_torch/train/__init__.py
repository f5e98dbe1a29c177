"""Training of the port: config, optimizer, precision policy, evaluation,
checkpoints, metric writers and the ``Trainer``."""
