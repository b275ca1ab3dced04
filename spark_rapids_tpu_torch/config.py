"""Typed configuration registry (the subset of `spark_rapids_tpu/config.py`
this engine reads).

Keys, types and defaults are the JAX package's, so one settings dict drives
both engines. `TpuConf` wraps a plain dict of user settings, with
environment overrides (`SPARK_RAPIDS_SQL_ENABLED=...`) exactly as the JAX
package applies them. Unregistered keys pass through raw.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Sequence

__all__ = ["ConfEntry", "TpuConf", "register", "get_default_conf",
           "parse_bytes", "UNPORTED_SWITCHES"]

_REGISTRY: Dict[str, "ConfEntry"] = {}

_SIZE_RE = re.compile(r"^(\d+(?:\.\d+)?)\s*([kmgt]?i?b?)$", re.IGNORECASE)
_SIZE_MULT = {
    "": 1, "b": 1,
    "k": 1 << 10, "kb": 1 << 10, "kib": 1 << 10,
    "m": 1 << 20, "mb": 1 << 20, "mib": 1 << 20,
    "g": 1 << 30, "gb": 1 << 30, "gib": 1 << 30,
    "t": 1 << 40, "tb": 1 << 40, "tib": 1 << 40,
}


def parse_bytes(v) -> int:
    """A byte size: an int, or a string such as '64m' or '1.5GiB'."""
    if isinstance(v, (int, float)):
        return int(v)
    m = _SIZE_RE.match(str(v).strip())
    if not m:
        raise ValueError(f"cannot parse byte size: {v!r}")
    return int(float(m.group(1)) * _SIZE_MULT[m.group(2).lower()])


def _convert(value: Any, typ: str) -> Any:
    if typ == "bool":
        if isinstance(value, bool):
            return value
        return str(value).strip().lower() in ("true", "1", "yes")
    if typ == "int":
        return int(value)
    if typ == "double":
        return float(value)
    if typ == "bytes":
        return parse_bytes(value)
    return str(value)


class ConfEntry:
    def __init__(self, key: str, typ: str, default: Any, doc: str,
                 check_values: Optional[Sequence[Any]] = None):
        self.key = key
        self.typ = typ
        self.default = default
        self.doc = doc
        self.check_values = tuple(check_values) if check_values else None

    def convert(self, raw: Any) -> Any:
        v = _convert(raw, self.typ)
        if self.check_values is not None and v not in self.check_values:
            raise ValueError(
                f"{self.key}={v!r} not in allowed values {self.check_values}")
        return v


def register(key: str, typ: str, default: Any, doc: str, **kw) -> ConfEntry:
    if key not in _REGISTRY:
        _REGISTRY[key] = ConfEntry(key, typ, default, doc, **kw)
    return _REGISTRY[key]


register("spark.rapids.sql.enabled", "bool", True,
         "Enable the columnar rewrite of SQL physical plans.")
register("spark.rapids.sql.mode", "string", "executeOnGPU",
         "executeOnGPU runs converted plans on the device; explainOnly only "
         "tags and reports what would run there, and runs the whole plan "
         "on the host engine.",
         check_values=("executeOnGPU", "explainOnly"))
register("spark.rapids.sql.test.enabled", "bool", False,
         "Strict test mode: any host fallback in a converted plan raises.")
register("spark.rapids.sql.incompatibleOps.enabled", "bool", True,
         "Allow ops marked incompat (minor semantic differences) on the "
         "device.")
register("spark.rapids.sql.optimizer.enabled", "bool", False,
         "Cost-based optimizer (plan/cbo.py): may keep device-capable plan "
         "sections on the host engine where the transitions would cost "
         "more than the device saves; the node shows `!` and the reason in "
         "explain.")
register("spark.rapids.sql.optimizer.cpuExecCost", "double", 1.0,
         "Relative per-row host operator cost.")
register("spark.rapids.sql.optimizer.gpuExecCost", "double", 0.3,
         "Relative per-row device operator cost.")
register("spark.rapids.sql.optimizer.transitionCost", "double", 10.0,
         "Relative per-row cost of a host <-> device transition.")
register("spark.rapids.tpu.scan.pushdown.enabled", "bool", False,
         "Scan pushdown (plan/scan_pushdown.py): fold supported filter "
         "predicates, pure column projections and global "
         "count/min/max/sum aggregates into the file scan. The device "
         "parquet decode tests each pushed leaf once per dictionary value "
         "and materialises only the surviving rows of the projected "
         "columns (an aggregate-only scan none); every other decode path "
         "applies the same spec exactly to its decoded batch.")
register("spark.rapids.tpu.scan.pushdown.aggregate.enabled", "bool", True,
         "Allow pushing global count/min/max/sum aggregates into the scan "
         "as partials merged by a rewritten aggregate (integral sums; "
         "integral, boolean, date and timestamp min/max; any count); off "
         "under ANSI. Ignored unless spark.rapids.tpu.scan.pushdown.enabled "
         "is on.")
register("spark.rapids.tpu.scan.pushdown.rowgroup.enabled", "bool", True,
         "Skip parquet row groups whose footer min/max/null counts prove "
         "that no row can pass the pushed predicate, before any page is "
         "read. Ignored unless spark.rapids.tpu.scan.pushdown.enabled is "
         "on.")
register("spark.rapids.sql.explain", "string", "NONE",
         "Explain output for the plan rewrite: NONE, NOT_ON_GPU (only "
         "fallback reasons), ALL.", check_values=("NONE", "NOT_ON_GPU", "ALL"))
register("spark.rapids.sql.batchSizeRows", "int", 1 << 20,
         "Target max rows per device batch.")
register("spark.rapids.sql.ansi.enabled", "bool", False,
         "ANSI mode: overflow/invalid-cast raise instead of null/wrap.")
register("spark.sql.ansi.enabled", "bool", False,
         "Host Spark's ANSI switch (honored like the rapids-namespace key).")
register("spark.rapids.sql.join.subPartition.rows", "int", 4 << 20,
         "Build sides larger than this hash-split into key-aligned "
         "sub-partitions joined pairwise.")
register("spark.rapids.sql.autoBroadcastJoinThreshold", "int", 10 << 20,
         "Build sides estimated at or below this many bytes join via a "
         "broadcast exchange instead of a shuffled join; -1 disables "
         "broadcast joins.")
register("spark.rapids.tpu.padding.minRows", "int", 128,
         "Minimum padded row bucket (lane-aligned).")
register("spark.rapids.tpu.padding.growth", "double", 2.0,
         "Row bucket growth factor (powers of this between min and max).")
register("spark.rapids.tpu.fusion.enabled", "bool", False,
         "Whole-stage fusion: a planner pass (plan/fusion.py) replaces "
         "maximal chains of project/filter/broadcast-join-probe operators "
         "with one fused stage that runs the members back to back per "
         "batch with one host sync for the join sizing.")
register("spark.rapids.tpu.fusion.minOps", "int", 2,
         "Minimum member count for a chain to be worth fusing (clamped "
         "to >= 2).")
register("spark.rapids.tpu.fusion.pallas.mode", "string", "auto",
         "Backend for the fused stage's hash-probe sizing: auto uses the "
         "hand-written kernel (ops/pallas_probe.py) when the session "
         "device is CUDA and the plain torch path on the CPU; off forces "
         "the plain path everywhere; force routes through the kernel "
         "wrapper on every device (on the CPU the wrapper takes its plain "
         "twin). All routes are bit-identical.",
         check_values=("auto", "off", "force"))
register("spark.rapids.shuffle.mode", "string", "MULTITHREADED",
         "MULTITHREADED: host-serialized threaded shuffle (reference "
         "default); ICI: the exchange between mesh positions that the "
         "distributed plan (exec/requirements.py) rides; CACHE_ONLY: "
         "device-resident local-only cache. This engine runs ICI only; "
         "an exchange under the other modes raises at plan time.",
         check_values=("MULTITHREADED", "ICI", "CACHE_ONLY"))
register("spark.rapids.shuffle.ici.slotRows", "int", 0,
         "Per-destination slot rows of the mesh exchange (0 = auto: the "
         "per-position capacity, which can never overflow). Smaller values "
         "bound skew memory; overflow is detected on the device and the "
         "exchange reruns with doubled slots.")
register("spark.rapids.tpu.mesh.shape", "string", "",
         "Logical mesh as 'name=N' (empty or 1 = single position, no "
         "mesh). Position i lives on cuda:(i % device_count) on a CUDA "
         "session, on the CPU on a CPU session; a mesh over more than one "
         "card raises at plan time.")
register("spark.rapids.tpu.mesh.enabled", "bool", False,
         "Sharded execution (the JAX package's mesh/plan.py): not in "
         "spark_rapids_tpu_torch yet, so true raises at plan time.")
register("spark.rapids.sql.format.parquet.enabled", "bool", True,
         "Enable the parquet scan.")
register("spark.rapids.sql.format.parquet.deviceDecode.enabled", "bool", True,
         "Decode parquet pages on the device (io/parquet_device.py); a "
         "column, row group or file the device decode declines is decoded "
         "by pyarrow and uploaded, and counted (parquet_device.COUNTERS). "
         "false sends every file to pyarrow's host decode.")
register("spark.rapids.sql.format.parquet.reader.type", "string", "AUTO",
         "Reader strategy of the parquet scan's host decode "
         "(io/multifile.py): AUTO, PERFILE, COALESCING, MULTITHREADED.",
         check_values=("AUTO", "PERFILE", "COALESCING", "MULTITHREADED"))
register("spark.rapids.sql.format.parquet.multiThreadedRead.numThreads", "int",
         20, "Threads of the process-wide multi-file reader pool.")
register("spark.rapids.sql.format.parquet.multiThreadedRead."
         "maxNumFilesParallel", "int", 2147483647,
         "Most files one scan decodes at once under MULTITHREADED.")
register("spark.rapids.cloudSchemes", "string", "s3,s3a,s3n,wasbs,gs,abfs,abfss",
         "URI schemes treated as cloud stores; selects MULTITHREADED reader "
         "under AUTO.")
register("spark.rapids.sql.dynamicFilePruning.enabled", "bool", True,
         "Prune probe-side parquet files and row groups of a broadcast hash "
         "join by the build side's distinct keys against the footer min/max "
         "statistics (io/dynamic_pruning.py). A join carrying such a filter "
         "is not fused, so it can fill the filter before the probe scan "
         "starts.")
register("spark.rapids.tpu.pipeline.enabled", "bool", True,
         "Pipelined execution: a background thread prefetches file-scan "
         "batches, and the parquet scan decodes "
         "pipeline.scan.chunksPerDispatch row groups per packed dispatch. "
         "Off: no thread, one row group per dispatch.")
register("spark.rapids.tpu.pipeline.prefetch.depth", "int", 2,
         "Batches the scan's prefetch thread may run ahead of its consumer.")
register("spark.rapids.tpu.pipeline.scan.chunksPerDispatch", "int", 4,
         "Row-group chunks the device parquet scan decodes per packed "
         "dispatch: their arrays pack into one host buffer, ship in one "
         "copy and merge into one batch. 1: row group by row group; "
         "ignored when spark.rapids.tpu.pipeline.enabled is false.")
register("spark.rapids.sql.topK.enabled", "bool", True,
         "Rewrite limit-over-sort into a top-k exec (per-batch k-select + "
         "running merge) instead of a full out-of-core sort "
         "(TakeOrderedAndProjectExec analog, GpuOverrides.scala:3705).")
register("spark.rapids.sql.topK.threshold", "int", 10000,
         "Largest LIMIT+OFFSET rewritten into the top-k exec (the "
         "spark.sql.execution.topKSortFallbackThreshold analog). Above it "
         "the planner keeps sort+limit: top-k holds an O(k) candidate "
         "batch device-resident and re-sorts ~2k rows per input batch, "
         "losing the out-of-core sort's spill behavior at large k.")

register("spark.rapids.sql.concurrentGpuTasks", "int", 2,
         "Number of tasks admitted concurrently to the device "
         "(memory/semaphore.py, the GpuSemaphore analog).")
register("spark.rapids.sql.test.injectRetryOOM", "int", 0,
         "Fault injection: force a RetryOOM on the Nth tracked device "
         "reservation (reference RapidsConf.scala:1250).")
register("spark.rapids.sql.test.injectSplitAndRetryOOM", "int", 0,
         "Fault injection: force a SplitAndRetryOOM on the Nth tracked "
         "reservation.")
register("spark.rapids.memory.gpu.allocFraction", "double", 0.9,
         "Fraction of the device's memory given to the budget of columnar "
         "data (reference GpuDeviceManager.computeRmmPoolSize).")
register("spark.rapids.memory.gpu.minAllocFraction", "double", 0.25,
         "Minimum fraction of the device's memory; startup fails below it.")
register("spark.rapids.memory.gpu.maxAllocFraction", "double", 1.0,
         "Maximum fraction of the device's memory allowed.")
register("spark.rapids.memory.gpu.reserve", "bytes", 640 << 20,
         "Device memory held back from the budget (allocator scratch and "
         "fragmentation).")
register("spark.rapids.memory.gpu.oomDumpDir", "string", "",
         "If set, the budget writes the spill catalog's state to this "
         "directory on an unrecoverable OOM.")
register("spark.rapids.memory.spill.compression.codec", "string", "zstd",
         "Codec of device batches spilled to host (TableCompressionCodec "
         "analog): none, zstd (pyarrow) or lz4xla (native/src/lz4block.cpp). "
         "Host accounting uses the compressed size.",
         check_values=("none", "zstd", "lz4xla"))
register("spark.rapids.memory.host.spillStorageSize", "bytes", 1 << 30,
         "Host-memory spill store capacity before overflowing to disk.")
register("spark.rapids.tpu.device.ordinal", "int", -1,
         "Which local CUDA device a session without a device binds "
         "(-1 = the first).")
register("spark.rapids.tpu.device.startupTimeoutSec", "double", 60.0,
         "Deadline (seconds) of the first device touch (CUDA init and the "
         "device count); a hung runtime raises DeviceStartupError with "
         "diagnostics instead of blocking the query. <= 0 disables the "
         "guard.")
register("spark.rapids.tpu.sched.enabled", "bool", False,
         "The JAX package's query scheduler (sched/): not in "
         "spark_rapids_tpu_torch yet, so true raises at plan time.")
register("spark.rapids.tpu.sched.tenant.quotas", "string", "",
         "Per-tenant device-memory sub-quotas (sched/): not in "
         "spark_rapids_tpu_torch yet, so a non-empty value raises at plan "
         "time.")
register("spark.rapids.tpu.mesh.hbmPerChip", "bytes", 0,
         "Per-chip memory sub-budgets of the sharded plan (mesh/): not in "
         "spark_rapids_tpu_torch yet, so a value above 0 raises at plan "
         "time.")
# the switches of JAX modules the port does not have, with the JAX
# defaults: a non-default value raises at plan time (plan/overrides.py
# _UNPORTED_KEYS)
UNPORTED_SWITCHES = (
    ("spark.rapids.sql.adaptive.enabled", "adaptive re-planning"),
    ("spark.rapids.tpu.stats.enabled", "runtime query statistics"),
    ("spark.rapids.tpu.stats.feedback.enabled",
     "optimizer feedback from the statistics history"),
    ("spark.rapids.tpu.rescache.enabled", "the result cache"),
    ("spark.rapids.tpu.telemetry.enabled", "live telemetry"),
    ("spark.rapids.tpu.live.enabled", "live query introspection"),
    ("spark.rapids.tpu.compile.warmup.enabled", "compile warmup"),
    ("spark.rapids.tpu.compile.tuner.enabled",
     "the adaptive bucket tuner"),
    ("spark.rapids.tpu.fleet.supervisor.enabled",
     "the fleet supervisor"),
    ("spark.rapids.tpu.metrics.profile.enabled", "the query profile"),
    ("spark.rapids.tpu.metrics.spans.kernel.enabled",
     "per-kernel profile spans"))
for _key, _what in UNPORTED_SWITCHES:
    register(_key, "bool", False,
             f"{_what[0].upper()}{_what[1:]} (the JAX package's): not in "
             "spark_rapids_tpu_torch yet, so true raises at plan time.")
register("spark.rapids.sql.regexp.enabled", "bool", True,
         "Enable regular-expression offload via the transpiler (falls "
         "back per-pattern).")
register("spark.rapids.tpu.string.headWidth", "int", 256,
         "Head width (bytes) of the long-string device layout: strings "
         "longer than this keep their first headWidth bytes in the "
         "rectangular byte matrix and the rest in a shared tail blob with "
         "per-row offsets, so one long value does not widen the whole "
         "column to cap x width. Byte-reading expressions over such a "
         "column rerun the plan on the host; row moves stay on the "
         "device.")


class TpuConf:
    """Instance view over a settings dict, with typed accessors."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings: Dict[str, Any] = dict(settings or {})
        for key in _REGISTRY:
            env = key.upper().replace(".", "_")
            if env in os.environ and key not in self._settings:
                self._settings[key] = os.environ[env]

    def get(self, key: str) -> Any:
        e = _REGISTRY.get(key)
        if e is None:
            return self._settings.get(key)
        if key in self._settings:
            return e.convert(self._settings[key])
        return e.default

    @property
    def is_sql_enabled(self) -> bool:
        return self.get("spark.rapids.sql.enabled")

    @property
    def is_test_enabled(self) -> bool:
        return self.get("spark.rapids.sql.test.enabled")

    @property
    def explain(self) -> str:
        return self.get("spark.rapids.sql.explain")

    @property
    def is_ansi(self) -> bool:
        return self.get("spark.rapids.sql.ansi.enabled") or \
            self.get("spark.sql.ansi.enabled")

    @property
    def batch_size_rows(self) -> int:
        return self.get("spark.rapids.sql.batchSizeRows")

    @property
    def concurrent_tpu_tasks(self) -> int:
        return self.get("spark.rapids.sql.concurrentGpuTasks")

    def is_operator_enabled(self, key: str, incompat: bool = False,
                            disabled_by_default: bool = False) -> bool:
        """A per-rule key (`spark.rapids.sql.exec.*`/`expression.*`) as the
        user set it; unset, an incompat rule follows
        `spark.rapids.sql.incompatibleOps.enabled`."""
        v = self._settings.get(key)
        if v is not None:
            return _convert(v, "bool")
        if disabled_by_default:
            return False
        if incompat:
            return self.get("spark.rapids.sql.incompatibleOps.enabled")
        return True


_default_conf: Optional[TpuConf] = None


def get_default_conf() -> TpuConf:
    global _default_conf
    if _default_conf is None:
        _default_conf = TpuConf()
    return _default_conf
