"""The data pipeline: report cleaning, the corpus vocabulary and its
WordPiece tokenizer, image and text datasets, ``ImSeq`` and the loader, and
the device half of the image preprocessing."""
