"""Host-side data contracts: sample types, conversation templates and
tokenizer adapters."""
