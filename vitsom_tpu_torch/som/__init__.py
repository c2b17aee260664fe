"""som — see the package docstring."""
