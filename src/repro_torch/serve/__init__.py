from .serve_loop import Server, make_decode_step, make_prefill

__all__ = ["Server", "make_decode_step", "make_prefill"]
