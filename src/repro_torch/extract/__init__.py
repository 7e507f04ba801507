from .cascade import CascadeExtractor, CascadeServedStats
from .oracle import OracleExtractor
from .served import ServedExtractor, ServedStats

__all__ = ["OracleExtractor", "ServedExtractor", "ServedStats",
           "CascadeExtractor", "CascadeServedStats"]
