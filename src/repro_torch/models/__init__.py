"""The LM substrate of the port: the dense family's serving path."""
from . import config, convert, layers, lm
from .config import ModelConfig
