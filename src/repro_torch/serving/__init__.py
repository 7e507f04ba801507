from .engine import Request, RunTruncated, ServingEngine

__all__ = ["ServingEngine", "Request", "RunTruncated"]
