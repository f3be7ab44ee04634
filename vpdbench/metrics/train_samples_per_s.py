"""train_samples_per_s: the samples of the window's completed epochs over
the window's wall time, up to the synchronize that ends it (host
clock). A sample is what the cell's `why` names. Read in every cell
whose driver's window counts samples trained (`MEASURES = 'train'`)."""


def read(r):
    w = r.get('window')
    if r.get('measures') != 'train' or not w or not w['seconds']:
        return None
    return w['samples'] / w['seconds']
