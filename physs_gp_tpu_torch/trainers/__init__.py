"""Trainers of the PyTorch port: host loops (`trainer.py`), loops that
keep their results on the device (`scan.py`), and L-BFGS with its
composites (`extra.py`)."""
from .scan import adam_scan, natgrad_scan, vb_ng_adam_scan  # noqa: F401
from .trainer import AdamTrainer, NatGradTrainer, VB_NG_Adam, lr_schedule  # noqa: F401
from .extra import LBFGSTrainer, SwitchTrainer, VB_NG_LBFGS  # noqa: F401
