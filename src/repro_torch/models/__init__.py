"""Models of the LM and recsys substrate (port of `repro/models`): the dense
decoder-only LM (`lm`) and the Behavior Sequence Transformer (`bst`)."""
