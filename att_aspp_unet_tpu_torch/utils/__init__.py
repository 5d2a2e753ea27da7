"""Weight loading and conversion."""
