"""End-to-end metric readers, one file a metric: ``end_to_end/<name>.py``'s
``read(w)`` takes the window's record ``w`` (``mode``, ``batch``,
``durations_s`` of every unit, ``window_s`` from the window's start to the
last completion, ``setup_s``) and returns a number, or None where the cell
has nothing for it."""
