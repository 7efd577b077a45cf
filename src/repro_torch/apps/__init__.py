"""Applications of bulk bitwise operations (paper Section 8)."""
