"""Loading: the mean host time of the port's image loader
(``io/image_loader.py::load_image_dataset``: the dataset folder's PNG
decode and float conversion) per capture, in the profiled pass, from the
benchmark's ``load`` range around the call. Nothing where no request
loaded a folder."""


def read(ctx):
    spans = ctx.prof.of("load")
    if not spans:
        return None
    return 1e3 * sum(s.seconds for s in spans) / len(spans)
