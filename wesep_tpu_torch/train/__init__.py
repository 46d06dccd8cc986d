"""Training engine: losses, schedules, the optimizer chain, the train and
eval steps, the epoch loop and checkpoint bundles."""
