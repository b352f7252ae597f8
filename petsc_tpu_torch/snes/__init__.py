from .snes import SNES, snes_reason_string
from .linesearch import LineSearch
from . import impls_more  # noqa: F401 — registers fas/vi/ncg/composite
