"""Entry points of the model zoo and the scheduler service: the training
and serving steps and their launchers, twin of ``repro/launch``."""
