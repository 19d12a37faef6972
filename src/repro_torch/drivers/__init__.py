"""Round drivers: schedulers over the RoundEngine phases.

    sync             the serial reference loop
    async_pipelined  up to S rounds of client training overlapped with the
                     oldest round's fusion, which runs on its own CUDA
                     stream (S = 0 keeps sync semantics)
    buffered_async   FedBuff-style waves over a registered population
    distributed      a fusion pod and client pods behind the versioned
                     wire protocol (``repro_torch.dist``; loopback or tcp)
    multihost        sync semantics with the client axis sharded over a
                     ``torch.distributed`` device mesh; ``drive_fed_rounds``
                     is the model zoo's federated round loop on a mesh
"""
from repro_torch.drivers.base import (Driver, available_drivers, get_driver,
                                      make_driver, register_driver,
                                      unwrap_state, wrap_state)
from repro_torch.drivers.async_pipelined import AsyncPipelinedDriver
from repro_torch.drivers.buffered_async import BufferedAsyncDriver
from repro_torch.drivers.multihost import MultiHostDriver, drive_fed_rounds
from repro_torch.drivers.sync import SyncDriver
from repro_torch.dist.driver import DistributedDriver

__all__ = ["AsyncPipelinedDriver", "BufferedAsyncDriver",
           "DistributedDriver", "Driver", "MultiHostDriver", "SyncDriver",
           "available_drivers", "drive_fed_rounds", "get_driver",
           "make_driver", "register_driver", "unwrap_state", "wrap_state"]
