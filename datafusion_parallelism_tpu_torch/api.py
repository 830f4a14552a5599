"""Session-level API (torch): config + SQL -> executable query.

Counterpart of the JAX package's `api.py`: a SessionConfig carrying the
join strategy, `target_partitions`, `replacement_required` and the
distributed settings, and a SessionContext that registers tables with
optional Statistics and plans SQL with the copied parser, planner and
optimizer. The session's tables live on one device, the card unless the
caller names another (`device="cpu"` runs the plain versions of the
kernels, as the tests do); a query whose biggest scan passes the
out-of-core thresholds streams or grace-partitions it
(runtime/executor.py). Every join runs under the config's strategy (CSR,
SORT or OA). With `target_partitions` P > 1 a query runs over P
partitions (runtime/distributed_executor.py): all of them in this process
on the session's device, or, when `torch.distributed` is initialised, one
per process of its process group (whose world size must be P).
`register_parquet` reads a parquet file, a directory of parts or a glob
through `utils/parquet_io.py` (pyarrow, imported then).
"""

from __future__ import annotations

from typing import Optional

import torch

from .models.planner import Planner
from .models.sql_parser import parse_sql
from .ops.hash_table import JoinStrategy
from .parallel.mesh import make_mesh
from .runtime.distributed_executor import DistributedQueryHandle
from .runtime.executor import QueryHandle
from .utils.catalog import Catalog, Statistics
from .utils.columnar import HostTable


class SessionConfig:
    def __init__(self, target_partitions: int = 1,
                 join_strategy: JoinStrategy = JoinStrategy.CSR,
                 replacement_required: bool = True,
                 broadcast_threshold: int = 4096,
                 skew_salting: Optional[bool] = None,
                 skew_factor: float = 8.0,
                 skew_threshold: float = 4.0,
                 distributed_staged: Optional[bool] = None):
        self.target_partitions = target_partitions
        self.join_strategy = join_strategy
        self.replacement_required = replacement_required
        # distributed settings: a join whose build side is estimated at
        # broadcast_threshold rows or fewer broadcasts it; skew_salting None
        # salts a join when the probe side's hottest key would load one
        # partition at >= skew_threshold x the balanced share, True/False
        # force it on/off; distributed_staged None stages multi-join plans
        # over large inputs (runtime/distributed_executor.py)
        self.broadcast_threshold = broadcast_threshold
        self.skew_salting = skew_salting
        self.skew_factor = skew_factor
        self.skew_threshold = skew_threshold
        self.distributed_staged = distributed_staged


class SessionContext:
    def __init__(self, config: Optional[SessionConfig] = None, *, device="cuda"):
        self.config = config or SessionConfig()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SessionContext: no CUDA device; pass device='cpu' to run "
                               "the kernels' plain versions on the CPU")
        self.catalog = Catalog(device=self.device)

    def _mesh(self):
        """The partitions a distributed query runs over: the initialised
        process group's, else all of them in process on the session's
        device."""
        import torch.distributed as dist
        P = self.config.target_partitions
        if dist.is_available() and dist.is_initialized():
            return make_mesh(P, self.device, process_group=True)
        return make_mesh(P, self.device)

    def register_table(self, name: str, table: HostTable,
                       statistics: Optional[Statistics] = None):
        self.catalog.register(name, table, statistics)

    def register_pydict(self, name: str, data: dict, dtypes=None,
                        statistics: Optional[Statistics] = None):
        self.register_table(name, HostTable.from_pydict(data, dtypes), statistics)

    def register_parquet(self, name: str, path: str,
                         statistics: Optional[Statistics] = None):
        from .utils.parquet_io import read_parquet
        self.register_table(name, read_parquet(path), statistics)

    def sql(self, query: str, **kernel_tables) -> QueryHandle:
        """Plan `query`; `kernel_tables` (kernels=, chain=) replace the
        kernel tables the query runs through (ops/join.py's JoinKernels,
        kernels/chain.py's ChainKernels)."""
        stmt = parse_sql(query)
        planned = Planner(self.catalog, self.config).plan(stmt)
        if self.config.target_partitions > 1:
            return DistributedQueryHandle(planned.plan, self.catalog, planned.scalar_subqueries,
                                          self.config, mesh=self._mesh(), **kernel_tables)
        return QueryHandle(planned.plan, self.catalog, planned.scalar_subqueries,
                           self.config, **kernel_tables)
