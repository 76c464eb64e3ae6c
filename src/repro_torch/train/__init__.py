"""The LM's train and serve steps (:mod:`.step`)."""
