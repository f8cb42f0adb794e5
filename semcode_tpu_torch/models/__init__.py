"""Models the engine runs: the transformer encoder (``encoder``), its
tokenizers (``tokenizer``), checkpoint reading and writing (``train``,
``hf_loader``) and the learned rerank table (``term_reranker``). Training
stays in the JAX package for now."""
