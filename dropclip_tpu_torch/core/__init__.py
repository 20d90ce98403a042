"""Config loading (``config``)."""
