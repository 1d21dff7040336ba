from .pipeline import SyntheticLM, FileTokens, Prefetcher

__all__ = ["SyntheticLM", "FileTokens", "Prefetcher"]
