"""Training of the port: presets, checkpoints and the Trainer."""
