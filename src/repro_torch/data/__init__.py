from .pipeline import MemmapLM, Prefetcher, SyntheticLM, write_token_file
