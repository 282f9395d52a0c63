"""TPC-H Q18 with the specification's row limit: the top 100 rows of ``q18``'s order."""

from .q18 import COLUMNS, ORDER_BY, run  # noqa: F401

LIMIT = 100
