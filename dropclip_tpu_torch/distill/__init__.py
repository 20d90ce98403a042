"""Student dispatch (``engine``); training steps come with slice 1b."""
