"""The data pipeline: report cleaning, the corpus vocabulary and its
WordPiece tokenizer, image, text, label and payload datasets, the
composites (``ImSeq``, ``Seq2Seq``, ``ImLabel``, ``ImSeqAny``) and the
loader, and the device half of the image preprocessing."""
