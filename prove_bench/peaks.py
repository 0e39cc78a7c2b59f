"""Published peaks of one NVIDIA H100 SXM5 (80 GB HBM3), at its full power
limit of 700 W; every run prints the card's name and power limit beside
the numbers it divides by these.

- HBM3: 3.35 TB/s (NVIDIA H100 data sheet).
- Tensor cores: 1,979 TOP/s of dense int8, two operations a MAC (data
  sheet). A 31-bit field product made exactly of 16 u8 x u8 MACs (the
  open kernels' byte-limb products) runs at most at a 32nd of that.
- CUDA cores: 132 SMs at a boost clock of 1,980 MHz (data sheet); 64
  32-bit integer multiply-adds, and as many integer additions, per SM per
  clock (CUDA C++ Programming Guide, arithmetic instructions, compute
  capability 9.0).
"""

HBM_BYTES_PER_S = 3.35e12
EXACT_PRODUCTS_PER_S = 1979e12 / 2 / 16
SMS = 132
CLOCK_HZ = 1.98e9
INT_LANES_PER_SM = 64
