"""PyTorch/CUDA port of the engine's main path, for one NVIDIA H100.

The JAX package ``spark_rapids_tpu`` is the reference; this package
imports nothing of it (nor ``jax``) and holds its own copies of what it
needs.  Module paths mirror the reference's, so each counterpart is
found under the same name:

  columnar/device.py    DeviceColumn, DeviceBatch, batch_to_device
  ops/carry.py          compact_rows (kernel K1), sort_order / sort_rows (K2)
  ops/segmented.py      order-preserving int64 key words, boundaries
  exec/aggregate.py     segment_reduce_sorted (kernel K3), the aggregate
  api/session.py        the DataFrame entry point

Classes named after the reference plugin and their JAX counterparts:

  GpuSession            spark_rapids_tpu.api.session.TpuSession
  GpuHashAggregateExec  spark_rapids_tpu.exec.aggregate.TpuHashAggregateExec

The slice covers scan -> filter -> group-by SUM/AVG/COUNT -> collect over
LONG, INT, DOUBLE and BOOLEAN columns.  Anything outside it raises
NotImplementedError naming what is missing.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; the hand-written
kernels (``csrc/``) run for CUDA tensors, their plain PyTorch versions
for CPU tensors.
"""
