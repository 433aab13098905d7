"""Real-time voices a card: V times the audio seconds of every call
completed in the window, over the window's seconds."""


def read(w) -> float:
    return w.voices * w.audio_s_per_call * w.calls / w.window_s
