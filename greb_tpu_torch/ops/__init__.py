"""Physics and circulation operators."""
