"""Data streams of the port (``pipeline.SyntheticLMStream``)."""
