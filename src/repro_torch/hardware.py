"""The card's published rates, which every bound of the port is reckoned with.

One NVIDIA H100 SXM5 with 80 GB of HBM3, the card that ``nvidia-smi
--query-gpu=name,power.limit`` names "NVIDIA H100 80GB HBM3", at its
700 W limit.  The figures are NVIDIA's H100 Tensor Core GPU data sheet's
(SXM column, dense rates without sparsity): HBM3 3.35 TB/s; 989 TFLOP/s
in bf16 on the tensor cores; 67 TFLOP/s in fp32 outside them (the rate
of the CUDA cores, which the BST descent's integer compares and selects
run on: the data sheet gives no int32 rate); fourth-generation NVLink 900
GB/s a card, both directions together, so 450 GB/s each way.  A card set
below 700 W runs slower under load: a measurement held to these figures
names the card's power limit beside it.  ``chip_smoke.py``'s bounds and
the dry runs (``launch/dryrun.py``, ``launch/dryrun_bst.py``) read this one
copy.
"""

CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700.0
HBM_BYTES = 80e9  # the card's memory
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12  # dense, tensor cores
FP32_FLOP_PER_S = 67e12  # the CUDA cores
NVLINK_BYTES_PER_S = 450e9  # one direction of the card's 900 GB/s
