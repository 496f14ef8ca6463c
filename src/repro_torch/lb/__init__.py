"""Dynamic load balancing (paper §6): partition arithmetic and Algorithm 2
(``partitioner``), the torch form of Algorithm 1 and its parts
(``jit_optimizer``), and the numpy-facing optimizer (``optimizer``)."""
