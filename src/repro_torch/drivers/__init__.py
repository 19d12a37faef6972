"""Round drivers: schedulers over the RoundEngine phases.  Only ``sync``
(the serial reference loop) is ported."""
from repro_torch.drivers.base import (Driver, available_drivers, get_driver,
                                      make_driver, register_driver)
from repro_torch.drivers.sync import SyncDriver

__all__ = ["Driver", "SyncDriver", "available_drivers", "get_driver",
           "make_driver", "register_driver"]
