"""The benchmark's harness: the cell's files found by name, the inputs made
from the seed, the clocks, the trace reduction and the comparison with the
plain reference.  It imports the port (``fusionocc_tpu_torch``) only to run
it, and never JAX or the JAX package."""
