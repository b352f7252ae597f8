from .tao import Tao
from . import impls_more  # noqa: F401 — bncg/owlqn/tron
