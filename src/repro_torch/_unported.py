"""What the port does not have yet, named for the errors that refuse it
(a leaf: it imports nothing, so any module may raise with it)."""

ITEM_9B = ("ROADMAP Queue 1 item 9b (the sharded stream steps, the sharded "
           "tuning search and ElasticController)")
