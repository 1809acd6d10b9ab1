"""Search operators: the exact oracle and the search dispatchers (``mips``),
the scan-and-select kernels B1-B8 with their wrappers, quantisers, merge and
refines (``mips_topt``), and the exact streaming top-k kernel B9
(``mips_stream``); ``_build`` compiles the CUDA sources at first use."""
