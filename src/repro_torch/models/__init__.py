"""The LM substrate of the port: the dense and moe families' serving and
training paths."""
from . import config, convert, layers, lm, moe
from .config import ModelConfig
