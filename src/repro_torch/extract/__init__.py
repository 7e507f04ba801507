from .oracle import OracleExtractor
from .served import ServedExtractor, ServedStats

__all__ = ["OracleExtractor", "ServedExtractor", "ServedStats"]
