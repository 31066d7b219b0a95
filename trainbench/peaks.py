"""The card's published peaks: NVIDIA H100 80GB HBM3 (SXM) at its 700 W
power limit, NVIDIA's data sheet, dense rates without sparsity (the
values of the program's ``launch/roofline.py``). A card set below 700 W
reaches less; every result carries the card's power limit beside it."""

BF16_FLOPS = 989e12        # tensor-core bfloat16, dense
FLOAT32_FLOPS = 67e12      # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # HBM3
CARD = "NVIDIA H100 80GB HBM3, 700 W"
