"""Core of the port: logical IR, optimizer, distribution lattice, physical
planner, per-rank operators, executor and the user API."""
from . import api, distribution, expr, ir, lower, optimizer, physical, table
from .api import *  # noqa: F401,F403
from .lower import ExecConfig
from .table import DTable
