"""parallel — see the package docstring."""
