"""`repro_torch.core.units`: the unit-constants module, core-plane spelling.

The implementation lives at `repro_torch.units` (the package root)
because `repro_torch.net` needs the constants at import time and
`repro_torch.core.__init__` imports `repro_torch.net`; core-plane
modules import from here (``from .units import ...``), and everything
is the same object either way.
"""

from repro_torch.units import *            # noqa: F401,F403  (re-export)
from repro_torch.units import __all__      # noqa: F401
