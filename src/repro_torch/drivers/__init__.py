"""Round drivers: schedulers over the RoundEngine phases.  Ported: ``sync``
(the serial reference loop) and ``buffered_async`` (FedBuff-style waves
over a registered population)."""
from repro_torch.drivers.base import (Driver, available_drivers, get_driver,
                                      make_driver, register_driver)
from repro_torch.drivers.buffered_async import BufferedAsyncDriver
from repro_torch.drivers.sync import SyncDriver

__all__ = ["BufferedAsyncDriver", "Driver", "SyncDriver",
           "available_drivers", "get_driver", "make_driver",
           "register_driver"]
