"""The reference's examples on the port: the paper's Fig. 8 experiments
(``python -m repro_torch.examples.logreg_higgs`` / ``pca_genomics``,
mirroring ``examples/logreg_higgs.py`` and ``examples/pca_genomics.py``) and
the model-zoo quickstart (``python -m repro_torch.examples.quickstart``,
mirroring ``examples/quickstart.py``)."""
