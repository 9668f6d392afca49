"""Training of the PyTorch port: losses, schedules, the optimizer, the
train and eval steps and the trainer."""
