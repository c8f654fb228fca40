"""Peak rates of one NVIDIA H100 SXM5 80GB, the denominators of portbench's
rooflines.

Source: NVIDIA H100 Tensor Core GPU datasheet, SXM5 column, dense rates
(no sparsity), which assume the card's full 700 W power limit. The run
prints the card's own power limit beside its result. Frozen from
`homulator_tpu_torch/benchlib.py` at commit 7ddbfaf4d401 (MEM_BYTES_PER_S,
INT32_OPS_PER_S, INT8_OPS_PER_S there).

  HBM_BYTES_PER_S        3.35 TB/s, published.
  FP32_FLOPS             67 TFLOP/s outside the tensor cores, published.
  INT32_OPS_PER_S        derived, not published: the float32 rate counts
                         128 lanes an SM, an FMA as two operations; an
                         H100 SM has 64 int32 lanes, one operation each,
                         so 67e12 / 4. The port's measured uint32 chain
                         (16.33 T/s, PERF.md) stays below it.
  INT8_TC_OPS_PER_S      1979 TOP/s, the dense int8 tensor-core rate,
                         published; a multiply-add counts two operations.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
INT32_OPS_PER_S = FP32_FLOPS / 4
INT8_TC_OPS_PER_S = 1979e12
