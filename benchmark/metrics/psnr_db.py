"""psnr_db: the mean over the window's points of the PSNR (peak 10000) of
the stream's decode, made after the window, against the scene."""


def read(run):
    return run.quality.get("psnr_db")
