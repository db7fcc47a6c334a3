"""`phiflow_tpu_torch.math`'s `Shape` against `phiflow_tpu.math`'s: the cases of
`tests/math/test_shape.py`, each run through both packages, names, sizes,
types and labels equal."""
import pytest

import phiflow_tpu.math as jm
import phiflow_tpu_torch.math as tm


def _same(a, b):
    assert a.names == b.names and a.sizes == b.sizes and a.types == b.types and a.labels == b.labels
    assert repr(a) == repr(b)


@pytest.mark.parametrize('build', [
    lambda m: m.spatial(x=64, y=32),
    lambda m: m.spatial('x,y'),
    lambda m: m.batch(b=10),
    lambda m: m.dual(vector='x,y'),
    lambda m: m.channel(vector='x,y,z'),
    lambda m: m.instance(points=7) & m.channel(vector=2),
], ids=['spatial', 'spatial-names', 'batch', 'dual', 'channel-labels', 'instance'])
def test_constructors(build):
    _same(build(tm), build(jm))
    s = build(tm)
    assert s.rank == build(jm).rank
    if s.well_defined:
        assert s.volume == build(jm).volume


def test_constructor_queries():
    d = tm.dual(vector='x,y')
    assert d.names == ('~vector',) and d.get_labels('~vector') == ('x', 'y')
    assert tm.batch(b=10).dims[0].is_batch
    v = tm.channel(vector='x,y,z')
    assert v.get_size('vector') == 3 and v.get_labels('vector') == jm.channel(vector='x,y,z').get_labels('vector')


@pytest.mark.parametrize('query', [
    lambda s: s.spatial, lambda s: s.non_batch, lambda s: s.only('x,vector'), lambda s: s.without('x'),
    lambda s: s - 'b', lambda s: s.channel, lambda s: s.batch, lambda s: s.non_channel,
], ids=['spatial', 'non_batch', 'only', 'without', 'sub', 'channel', 'batch', 'non_channel'])
def test_filtering(query):
    _same(query(tm.batch(b=2) & tm.spatial(x=4, y=3) & tm.channel(vector='x,y')),
          query(jm.batch(b=2) & jm.spatial(x=4, y=3) & jm.channel(vector='x,y')))


@pytest.mark.parametrize('shapes', [
    lambda m: (m.spatial(x=4), m.spatial(y=3) & m.channel(vector=2)),
    lambda m: (m.spatial(x=4), m.batch(b=2)),
    lambda m: (m.channel(vector='x,y'), m.dual(vector='x,y'), m.spatial(y=3, x=2)),
], ids=['spatial-channel', 'batch-first', 'dual'])
def test_merge(shapes):
    _same(tm.merge_shapes(*shapes(tm)), jm.merge_shapes(*shapes(jm)))
    _same(tm.concat_shapes(*shapes(tm)), jm.concat_shapes(*shapes(jm)))


def test_merge_conflict_raises():
    with pytest.raises(tm.IncompatibleShapes):
        tm.merge_shapes(tm.spatial(x=4), tm.spatial(x=5))


def test_arithmetic():
    _same(tm.spatial(x=64) + 1, jm.spatial(x=64) + 1)


@pytest.mark.parametrize('index', [lambda s: s['x'], lambda s: s[0], lambda s: s.reversed, lambda s: s[1:],
                                   lambda s: s.with_dim_size('y', 7), lambda s: s.as_batch()],
                         ids=['name', 'int', 'reversed', 'slice', 'with_dim_size', 'as_batch'])
def test_indexing(index):
    _same(index(tm.spatial(x=4, y=3)), index(jm.spatial(x=4, y=3)))
    assert tm.spatial(x=4, y=3)['x'].size == 4 and tm.spatial(x=4, y=3)[0].name == 'x'


def test_parse_dim_order_and_after_gather():
    from phiflow_tpu.math._shape import after_gather as j_after
    from phiflow_tpu_torch.math._shape import after_gather as t_after
    assert tm.parse_dim_order('x, y,z') == jm.parse_dim_order('x, y,z')
    sel = {'x': slice(1, 3), 'vector': 'x', 'y': [0, 2]}
    _same(t_after(tm.spatial(x=4, y=3) & tm.channel(vector='x,y'), sel),
          j_after(jm.spatial(x=4, y=3) & jm.channel(vector='x,y'), sel))
