"""PyTorch/CUDA port of the engine, for one NVIDIA H100.

The JAX package ``spark_rapids_tpu`` is the reference; this package
imports nothing of it (nor ``jax``) and holds its own copies of what it
needs.  Module paths mirror the reference's, so each counterpart is
found under the same name:

  api/session.py        the DataFrame entry point, its conf and explain
  plan/planner.py       logical plan -> CPU-placed physical plan
  plan/overrides.py     tag -> cost -> convert -> transitions
  columnar/device.py    DeviceColumn, DeviceBatch, batch_to_device
  columnar/fetch.py     the packed download: lane_stats (K9), pack_lanes (K10)
  ops/carry.py          compact_rows (kernel K1), sort_order / sort_rows (K2)
  ops/gather.py         gather_rows (kernel K8), the row gathers
  ops/segmented.py      order-preserving int64 key words, boundaries
  ops/int128.py         128-bit decimal arithmetic over int64 pairs
  exec/aggregate.py     segment_reduce_sorted (kernel K3), the aggregates
  ops/join_kernels.py   the join kernels K4-K7
  exec/join.py          the hash, nested-loop and CPU joins
  exec/sort.py          the sort; exec/basic.py the limits
  io/reader.py, io/scan.py, io/writer.py
                        session.read, the file scan and its device pin,
                        DataFrame.write
  plan/host_assist.py   the host-assisted collect of a sorted table

Classes named after the reference plugin and their JAX counterparts:

  GpuSession            spark_rapids_tpu.api.session.TpuSession
  GpuOverrides          spark_rapids_tpu.plan.overrides.TpuOverrides
  GpuHashAggregateExec  spark_rapids_tpu.exec.aggregate.TpuHashAggregateExec

The port carries BOOLEAN, BYTE, SHORT, INT, LONG, FLOAT, DOUBLE, DATE,
TIMESTAMP, DECIMAL and STRING columns (and the NULL type of
``lit(None)``); another column type (binary, lists, maps, structs)
raises NotImplementedError naming what is missing.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; the hand-written kernels (``csrc/``) run for
CUDA tensors, their plain PyTorch versions for CPU tensors, so a
CPU-placed operator runs the plain versions.
"""
