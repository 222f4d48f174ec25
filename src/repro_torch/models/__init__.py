"""The LM substrate of the port: the dense, moe, ssm, hybrid and vlm
families (models/lm.py) and the encdec family (models/whisper.py), serving
and training."""
from . import config, convert, layers, lm, moe, ssm, whisper
from .config import ModelConfig
