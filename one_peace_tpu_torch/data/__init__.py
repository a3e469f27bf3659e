"""Host-side data: the tokenizer, the FLAC reader, TSV tables, collation,
the epoch batch iterator and the retrieval datasets."""
