"""TPC-H Q10 with the specification's row limit: the top 20 rows of ``q10``'s order."""

from .q10 import COLUMNS, ORDER_BY, run  # noqa: F401

LIMIT = 20
