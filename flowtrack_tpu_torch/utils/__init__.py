"""Weight conversion from the reference package."""
