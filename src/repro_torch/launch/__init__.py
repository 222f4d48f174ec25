"""Entry points of the port: the LM substrate's serving steps (``steps``)
and the data-frame serving session (``python -m repro_torch.launch.serve``,
not imported here so that ``-m`` runs it once)."""
from . import steps
