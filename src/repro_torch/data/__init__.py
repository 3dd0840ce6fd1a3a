from .pipeline import DataConfig, SyntheticLMData, pack_documents  # noqa: F401
