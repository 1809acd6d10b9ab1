"""Search operators: the exact oracle (``mips``) and the int8r scan with its
CUDA kernel (``mips_topt``)."""
