"""The optimizer of the port: AdamW with global-norm clipping and LR
schedules (``adamw``)."""
from . import adamw
from .adamw import OptConfig
