"""Model core and driver."""
