"""The chip's published peaks (NVIDIA H100 SXM data sheet, dense rates,
at the full 700 W power limit), and the prices of the algorithms' field
operations on the 8 x 32-bit words that one 252-bit element fills."""

HBM_BYTES_PER_S = 3.35e12

# The fastest exact integer multiply: the int8 tensor cores, 1,979 TOP/s
# dense, i.e. 989.5 T multiply-adds a second.  A 32 x 32-bit word product
# is taken as 16 byte products.
INT8_MACS_PER_S = 989.5e12
WORD_PRODUCTS_PER_S = INT8_MACS_PER_S / 16

# The CUDA cores' INT32 multiply rate (132 SMs x 64 a clock x 1.98 GHz):
# not the roofline's basis, given beside it for comparison.
INT32_WORD_PRODUCTS_PER_S = 132 * 64 * 1.98e9

# 32 x 32-bit word products of one field multiply and one square of
# 8-word elements (schoolbook plus Montgomery reduction), fixed here
# whatever multiply the program uses.
WORDS_PER_MUL = 104
WORDS_PER_SQUARE = 76

# One element of the tensor boundary: 22 int32 limbs of radix 2^12.
LIMB_BYTES = 22 * 4
POINT_BYTES = 4 * LIMB_BYTES
