from .ts import TS, TSAdapt
from . import impls_more  # noqa: F401 — symplectic/pseudo/alpha
