"""The paper's Fig. 8 experiments on the port (``python -m
repro_torch.examples.logreg_higgs`` / ``pca_genomics``), mirroring the JAX
package's ``examples/logreg_higgs.py`` and ``examples/pca_genomics.py``."""
