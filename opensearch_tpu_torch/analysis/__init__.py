from .analyzers import AnalysisRegistry, Analyzer

__all__ = ["AnalysisRegistry", "Analyzer"]
