"""Rule modules — importing this package registers every rule."""

from . import (donation, host_sync, kernel, key_reuse,  # noqa: F401
               recompile, sim_determinism)
