"""Training of the port: losses, optimizers, the train step, the trainer and its checkpoints."""
