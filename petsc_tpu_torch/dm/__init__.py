from .dm import DM
from .da import DMDA
from .plex import DMPlex, Section
