"""The LM substrate of the port: the dense, moe, ssm and hybrid families'
serving and training paths."""
from . import config, convert, layers, lm, moe, ssm
from .config import ModelConfig
