"""Problems and their torch kernels (``repro.core``)."""
