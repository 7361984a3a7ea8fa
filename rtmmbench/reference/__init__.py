"""The benchmark's plain reference: float32 PyTorch forwards of the served
architectures, written from their published equations, that import nothing
of the program under test (``model``), and the parameter layout both sides
are handed (``model.param_layout``)."""
