"""Trainers of the PyTorch port: host loops (`trainer.py`) and loops that
keep their results on the device (`scan.py`)."""
from .scan import adam_scan, natgrad_scan, vb_ng_adam_scan  # noqa: F401
from .trainer import AdamTrainer, NatGradTrainer, VB_NG_Adam, lr_schedule  # noqa: F401
