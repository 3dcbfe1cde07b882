"""Training runtime of the port: losses, metrics, optimizers, the train and
eval steps and the ``fit`` / ``evaluate`` / ``predict`` loops."""
