"""Device operators of the port: the blocked operator (``blocked``), the
emission inputs (``emissions``) and the blocked forward-backward scan with
its CUDA kernels (``block_scan``, sources in ``csrc/``)."""
