"""The token pipeline of the LM's training path (:mod:`.pipeline`)."""
