"""Host-side utilities of the port."""
from .quantity import parse_quantity
