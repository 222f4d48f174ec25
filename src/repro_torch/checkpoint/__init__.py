"""Atomic, asynchronous checkpoints in the reference package's on-disk
format (``ckpt``)."""
from . import ckpt
from .ckpt import AsyncSaver, copy_into, latest_step, restore, save
