"""The port of ``example/rnn/``: the bucketed LSTM classifier."""
