"""TPC-H Q3 with the specification's row limit: the top 10 rows of ``q3``'s order."""

from .q3 import COLUMNS, ORDER_BY, run  # noqa: F401

LIMIT = 10
