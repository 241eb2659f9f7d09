"""Entry points (``serve``)."""
