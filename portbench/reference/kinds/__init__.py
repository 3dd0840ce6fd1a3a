"""The reference's blocks, one file a layer kind (`reference.lm.kind`)."""
