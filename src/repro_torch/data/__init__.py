from .pipeline import (CorpusMeta, DataConfig, FilteredSyntheticLM,
                       SyntheticLM, filter_documents, synth_corpus_meta)
