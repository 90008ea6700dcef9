"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense, at its full
700 W power limit (NVIDIA's data sheet): the denominators of every roofline
share the benchmark reports."""

#: HBM3 bandwidth, bytes a second.
HBM_BYTES_PER_S = 3.35e12
#: float32 operations a second outside the tensor cores; the integer and
#: float recurrences the port's kernels run are held to it.
VECTOR_OPS_PER_S = 67e12
