"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data
sheet, dense rates without sparsity, at the full 700 W power limit.

Which peak applies to what:

* ``BYTES`` (3.35 TB/s): every byte a kernel must read or write.
* ``TF32`` (495 TFLOP/s, tensor cores): the float32 Gram, counted as
  three TF32 products (hi x hi, hi x lo, lo x hi), the least work that
  keeps float32's precision on the tensor cores.
* ``F64`` (67 TFLOP/s, the float64 tensor cores): every float64 operation
  the work counts hold.  The matrix-shaped float64 work (the rows' x.beta
  and x^T r, the LU solve) runs at this rate on the tensor cores; the
  elementwise float64 work (sigmoid, logs) runs on the CUDA cores at 34
  TFLOP/s.  A roofline is a least time, so it charges all float64
  operations at the higher rate: no correct implementation reads above
  100% because of this choice.
* ``BF16`` (989 TFLOP/s, tensor cores): the flash attention kernels' bf16
  products, and a training step's model FLOPs (``train_mfu``).
* ``F32`` (67 TFLOP/s, CUDA cores): the flash kernels' float32
  instantiation; no cell runs it.
"""
BYTES = 3.35e12
TF32 = 495e12
F64 = 67e12
F32 = 67e12
BF16 = 989e12

# the rate each operation type of ``work.Work`` is charged at
RATE = {"tf32": TF32, "f64": F64, "f32": F32, "bf16": BF16}
