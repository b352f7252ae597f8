from .dm import DM
from .da import DMDA
from .composite import DMComposite, DMShell, DMRedundant
from .stag import DMStag
from .plex import DMPlex, Section
