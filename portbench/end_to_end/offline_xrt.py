"""Audio seconds of every track completed in the window over the window's
seconds (a track is one voice)."""


def read(w) -> float:
    return w.voices * w.audio_s_per_call * w.calls / w.window_s
