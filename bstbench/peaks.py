"""The peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at
its 700 W limit): the roofline's denominators, kept with the benchmark so
that no change to the program moves them."""

HBM_BYTES_PER_S = 3.35e12
BF16_DENSE_FLOP_PER_S = 989e12
