"""Method semantics shared by the engines (``repro.cluster``)."""
