"""Host-side utilities: the key-value metric logger."""
